"""The multi-index-hashing index: per-table entry arrays on the device.

Port of the range-directory layouts of ``verticut_tpu/index/mih.py``. Per
table, one stable sort of the substrings orders the entries by
``(substring, id)``; a range directory maps substring prefixes to row
ranges; the entries are stored in one of two blocked layouts:

* inline (``store_codes=True``): word-major ``(id, code)`` rows,
  ``entry_block_size(W)`` entries per row (25 at W = 4), so one gathered
  row scores a whole block;
* compact (``store_codes=False``): id-only rows of :data:`ID_ROW_BLOCK`
  ids; candidate codes are gathered from the shared id-ordered ``codes``.

``keep_entry_ids=False`` drops the flat id column (the blocked rows hold
the ids as well), as the reference drops it above 20M codes.
:func:`save_index` and :func:`load_index` read and write the reference's
``.npz`` keys, so a file written by either package loads in the other.

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

#: ids per compact-layout row (128 B), and the id-count alignment (4 rows)
ID_ROW_BLOCK = 32
ID_ROW_ALIGN = 128

#: entries assembled at a time into the inline rows: bounds the build's
#: gathered-code temporaries (~0.3 GB at W = 4) at any corpus size
ASSEMBLY_CHUNK = 4 * 1024 * 1024


class MIHTable(NamedTuple):
    """One substring hash table."""

    entry_ids: Optional[torch.Tensor]  # int32[N] ids in substring order
    directory: dir_lib.RangeDirectory
    # inline layout: int32[NB, blk*RW], one row = one blk-entry block
    # stored word-major (lane w*blk + r = word w of entry r; word 0 = id,
    # words 1..W = code; pad entries carry id -1 and a zero code)
    entry_rows: Optional[torch.Tensor] = None
    # compact layout: int32[NBc, ID_ROW_BLOCK] ids, pad id -1
    entry_idrows: Optional[torch.Tensor] = None

    def n_entries(self, n_words: int) -> int:
        """Entry count (the padded count of the blocked rows when the flat
        ids are absent)."""
        if self.entry_ids is not None:
            return self.entry_ids.shape[0]
        if self.entry_idrows is not None:
            return self.entry_idrows.numel()
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
        return self.tables[0].directory.se.device

    @property
    def compact(self) -> bool:
        """Whether the tables hold id-only rows (codes gathered from
        ``codes``)."""
        return self.tables[0].entry_rows is None

    def fetch_block(self) -> int:
        """Entries per fetched row of the tables' layout."""
        return (ID_ROW_BLOCK if self.compact
                else entry_block_size(self.cfg.n_words))

    def table_subs(self, queries: torch.Tensor) -> torch.Tensor:
        """Substring values of a query batch for every table: [Q, m]."""
        return codes_lib.all_substrings(queries, self.cfg.n_tables)


def _padded_ids(sorted_ids: torch.Tensor, npad: int) -> torch.Tensor:
    out = torch.full((npad,), -1, dtype=torch.int32, device=sorted_ids.device)
    out[:sorted_ids.shape[0]] = sorted_ids
    return out


def make_entry_idrows(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Compact-layout rows: the ids padded with -1 to a multiple of
    :data:`ID_ROW_ALIGN`, :data:`ID_ROW_BLOCK` per row."""
    n = sorted_ids.shape[0]
    npad = -(-max(n, 1) // ID_ROW_ALIGN) * ID_ROW_ALIGN
    return _padded_ids(sorted_ids, npad).reshape(-1, ID_ROW_BLOCK)


def make_entry_rows(sorted_ids: torch.Tensor, codes: torch.Tensor
                    ) -> torch.Tensor:
    """Blocked word-major ``(id, code)`` rows, padded as the JAX package's
    native build pads them (``index/build_native._host_entry_rows``):
    entries to a multiple of ``entry_row_align(W)``, pad ids -1. Assembled
    :data:`ASSEMBLY_CHUNK` entries at a time into the output, so no
    ``[Npad, RW]`` copy of the table exists besides the rows themselves."""
    n, w = codes.shape
    rw = _row_width(w)
    blk = entry_block_size(w)
    align = entry_row_align(w)
    npad = -(-max(n, 1) // align) * align
    ids = _padded_ids(sorted_ids, npad)
    out = torch.empty((npad // blk, blk * rw), dtype=torch.int32,
                      device=codes.device)
    ch = ASSEMBLY_CHUNK // blk * blk
    for c0 in range(0, npad, ch):
        idc = ids[c0:c0 + ch]
        g = codes[idc.clamp(min=0).long()]
        g[idc < 0] = 0
        rows = torch.cat([idc[:, None], g], dim=1)          # [ch, rw]
        out[c0 // blk:(c0 + idc.shape[0]) // blk] = rows.reshape(
            -1, blk, rw).transpose(1, 2).reshape(-1, blk * rw)
    return out


def sort_table(codes: torch.Tensor, table_id: int, s_bits: int):
    """One table's ``(sorted substrings, sorted ids)``: a stable sort of
    the substring column, whose id order within equal substrings is the
    corpus order (the reference's ``(substring, id)`` sort). Substrings are
    int32 bit patterns; flipping the sign bit makes their signed order the
    unsigned one. Returns int32 bit patterns and int32 ids."""
    subs = codes_lib.substring(codes, table_id, s_bits)
    sign = torch.iinfo(torch.int32).min
    keys, order = torch.sort(subs ^ sign, stable=True)
    del subs
    return keys ^ sign, order.to(torch.int32)


def build_index(codes_arr, cfg: MIHConfig = MIHConfig(), *,
                device=None, directory: str = "range",
                store_codes: bool = True, keep_entry_ids: bool = True,
                keep_codes: bool = True) -> MIHIndex:
    """Build the m-table index on ``device``: by default the card for numpy
    codes (raising where there is none) and the tensor's own device for a
    tensor.

    ``codes_arr``: ``uint32[N, W]`` numpy codes or an ``int32[N, W]``
    tensor; row i is id i. ``store_codes`` picks the inline layout (else
    the compact one, which needs the codes kept); ``keep_entry_ids`` keeps
    the flat id column; ``keep_codes`` keeps ``codes`` for the scan tier
    and the linear fallback. Only the range directory is ported
    (ROADMAP.md Queue 1 item 8 holds the rest). Rows are padded as the JAX
    package's native build pads them; its device build pads alike up to
    5M codes and in 5M-entry chunks above."""
    if directory != "range":
        raise NotImplementedError(
            f"directory={directory!r}: only the range directory is ported; "
            "the legacy bucket directories are ROADMAP.md Queue 1 item 8")
    if not (store_codes or keep_codes):
        raise ValueError("the compact layout (store_codes=False) gathers "
                         "candidate codes from the kept codes")
    codes = bits_lib.as_codes(
        codes_arr, bits_lib.entry_device(device, codes_arr)).contiguous()
    if codes.ndim != 2 or codes.shape[-1] != cfg.n_words:
        raise ValueError(
            f"codes have shape {tuple(codes.shape)}, config wants "
            f"[N, {cfg.n_words}]")
    n = codes.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{n} codes do not fit int32 ids")
    pbits = dir_lib.pick_range_pbits(
        n, cfg.s_bits,
        entry_block_size(cfg.n_words) if store_codes else ID_ROW_BLOCK)
    tables = []
    for t in range(cfg.n_tables):
        sorted_subs, sorted_ids = sort_table(codes, t, cfg.s_bits)
        d = dir_lib.build_range(sorted_subs, cfg.s_bits, pbits=pbits)
        del sorted_subs
        tables.append(MIHTable(
            entry_ids=sorted_ids if keep_entry_ids else None, directory=d,
            entry_rows=(make_entry_rows(sorted_ids, codes) if store_codes
                        else None),
            entry_idrows=None if store_codes else make_entry_idrows(
                sorted_ids)))
        del sorted_ids
    return MIHIndex(cfg=cfg, tables=tables, n=n,
                    codes=codes if keep_codes else None)


# --------------------------------------------------------------------------
# Persistence: the reference's .npz keys, both directions
# --------------------------------------------------------------------------

def save_index(path: str, index: MIHIndex) -> None:
    """Write the index as the reference's ``save_index`` does: ``n``,
    ``bits``, ``n_tables``, ``codes`` (if kept), and per table ``t{t}_se``
    and whichever of ``t{t}_ids``, ``t{t}_rows``, ``t{t}_idrows`` it holds,
    in the reference's dtypes (uint32 codes and rows, int32 ids and
    ranges)."""
    arrs = {"n": np.asarray(index.n), "bits": np.asarray(index.cfg.bits),
            "n_tables": np.asarray(index.cfg.n_tables)}
    if index.codes is not None:
        arrs["codes"] = bits_lib.to_u32(index.codes)
    for t, tab in enumerate(index.tables):
        arrs[f"t{t}_se"] = tab.directory.se.cpu().numpy()
        if tab.entry_ids is not None:
            arrs[f"t{t}_ids"] = tab.entry_ids.cpu().numpy()
        if tab.entry_rows is not None:
            arrs[f"t{t}_rows"] = bits_lib.to_u32(tab.entry_rows)
        if tab.entry_idrows is not None:
            arrs[f"t{t}_idrows"] = bits_lib.to_u32(tab.entry_idrows)
    np.savez(path, **arrs)


def load_index(path: str, device=None) -> MIHIndex:
    """Read an index written by :func:`save_index` or by the reference's
    ``save_index`` (range tables) onto ``device`` (by default the card,
    raising where there is none)."""
    device = bits_lib.entry_device(device)
    with np.load(path) as z:
        return index_from_arrays(z, device=device)


def index_from_arrays(arrays: Mapping[str, np.ndarray],
                      device=None) -> MIHIndex:
    """The index held by the arrays of a saved ``.npz`` file (see
    :func:`save_index`), on ``device`` (by default the card, raising where
    there is none). Range tables only: a table saved with another
    directory or with per-entry code copies raises."""
    device = bits_lib.entry_device(device)
    cfg = MIHConfig(bits=int(arrays["bits"]), n_tables=int(arrays["n_tables"]))
    n = int(arrays["n"])
    want = entry_block_size(cfg.n_words) * _row_width(cfg.n_words)

    def tensor(key):
        return (bits_lib.as_codes(arrays[key], device)
                if key in arrays else None)

    tables = []
    for t in range(cfg.n_tables):
        if f"t{t}_se" not in arrays or f"t{t}_codes" in arrays:
            raise NotImplementedError(
                f"table {t} is not a range table with blocked entry rows; "
                "the legacy bucket layouts are ROADMAP.md Queue 1 item 8")
        rows, idrows = tensor(f"t{t}_rows"), tensor(f"t{t}_idrows")
        if (rows is None) == (idrows is None):
            raise ValueError(f"table {t} must hold exactly one of t{t}_rows "
                             f"and t{t}_idrows")
        if rows is not None and (rows.ndim != 2 or rows.shape[1] != want):
            raise ValueError(f"t{t}_rows has shape {tuple(rows.shape)}; the "
                             f"blocked layout has {want} words per row")
        if idrows is not None and (idrows.ndim != 2
                                   or idrows.shape[1] != ID_ROW_BLOCK):
            raise ValueError(f"t{t}_idrows has shape {tuple(idrows.shape)}"
                             f"; the compact layout has {ID_ROW_BLOCK} ids "
                             "per row")
        se = torch.from_numpy(np.ascontiguousarray(arrays[f"t{t}_se"],
                                                   np.int32)).to(device)
        tables.append(MIHTable(
            entry_ids=tensor(f"t{t}_ids"),
            directory=dir_lib.RangeDirectory(se=se, s_bits=cfg.s_bits),
            entry_rows=rows, entry_idrows=idrows))
    codes = tensor("codes")
    if tables[0].entry_rows is None and codes is None:
        raise ValueError("a compact index needs its codes")
    return MIHIndex(cfg=cfg, tables=tables, n=n, codes=codes)
